from fancyrec_tpu_torch.io.bigfile import BigFileReader, BigFileWriter, ImageBigFile, WordBigFile
from fancyrec_tpu_torch.io.dictfile import read_dict, write_dict
from fancyrec_tpu_torch.io.vocab import Vocabulary, Bow2Vec, clean_str, build_vocab

__all__ = [
    "BigFileReader", "BigFileWriter", "ImageBigFile", "WordBigFile",
    "read_dict", "write_dict",
    "Vocabulary", "Bow2Vec", "clean_str", "build_vocab",
]
