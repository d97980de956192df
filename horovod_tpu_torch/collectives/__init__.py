"""Collectives over ``torch.distributed`` and their wire compression."""
