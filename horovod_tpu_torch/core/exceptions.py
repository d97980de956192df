"""Exception types mirroring the reference's ``horovod/common/exceptions.py``.

The port's own copy of ``horovod_tpu/core/exceptions.py``:
``HorovodInternalError`` is the signal the elastic layer catches to trigger
comm re-initialisation + state restore; ``HostsUpdatedInterrupt`` is raised
when the elastic coordinator notifies workers of a membership change,
triggering re-init + state sync instead of rollback.
"""


class HorovodInternalError(RuntimeError):
    """An irrecoverable collective/runtime failure.

    Under elastic training this triggers shutdown → re-init →
    ``state.restore()``.
    """


class HostsUpdatedInterrupt(RuntimeError):
    """Raised when the host membership changed under elastic training.

    Triggers re-init → ``state.sync()`` (broadcast from the new rank 0).
    """

    def __init__(self, skip_sync: bool = False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class PreemptionInterrupt(HostsUpdatedInterrupt):
    """Raised at the step seam when a preemption notice (SIGTERM/SIGUSR1)
    was observed.

    Subclasses :class:`HostsUpdatedInterrupt` so code that only knows the
    graceful-reset path handles it identically.
    """

    def __init__(self, signum: int = 0):
        super().__init__(skip_sync=True)
        self.signum = signum


class NotInitializedError(RuntimeError):
    """An API needing an initialised context was called before ``init()``."""

    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call horovod_tpu_torch.init() "
            "first."
        )
