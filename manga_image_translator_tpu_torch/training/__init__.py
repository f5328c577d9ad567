from .ctc import custom_ctc_loss

__all__ = ['custom_ctc_loss']
