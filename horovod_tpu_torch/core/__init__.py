"""Process model, config and process sets over ``torch.distributed``."""
