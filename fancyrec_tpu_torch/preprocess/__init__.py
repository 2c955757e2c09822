"""Offline preprocessing: scrape tree -> BigFiles, captions, splits and
vocabularies (port of fancyrec_tpu/preprocess). Docstring only, so the
spawned decode workers import nothing heavy."""
