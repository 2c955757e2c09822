from fancyrec_tpu_torch.models.fancyrec import FancyRec, init_fancyrec

__all__ = ["FancyRec", "init_fancyrec"]
