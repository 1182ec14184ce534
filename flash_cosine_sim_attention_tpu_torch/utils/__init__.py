from .checkpoint import restore_checkpoint, save_checkpoint

__all__ = ["restore_checkpoint", "save_checkpoint"]
