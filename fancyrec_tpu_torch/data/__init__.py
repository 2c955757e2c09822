from fancyrec_tpu_torch.data.dataset import CaptionSet, PostDataset
from fancyrec_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from fancyrec_tpu_torch.data.tokenizer import WordPieceTokenizer

__all__ = [
    "CaptionSet", "PostDataset", "BatchLoader", "prefetch_to_device",
    "WordPieceTokenizer",
]
