"""fancyrec-tpu on PyTorch and CUDA: the port of `fancyrec_tpu` to an NVIDIA
H100 (Hopper, sm_90a).

The JAX package stays the reference; this package mirrors its layout and
module names, imports nothing of it, and replaces each Pallas TPU kernel on
its path with a CUDA kernel written for Hopper (`csrc/`), built at first use
with `nvcc` and bound with `ctypes`. Entry points run on CUDA unless the
caller asks for the CPU (`device="cpu"`, `--device cpu`); on CPU tensors the
kernel wrappers run their plain PyTorch versions.

Ported so far: the serving path -- index build (post encoding through the
full FancyRec towers), the int8 top-k, and the HTTP service -- and the
training path: the trainer CLI (`fancyrec_tpu_torch.train.trainer`), its
losses, train step, ranking metrics and checkpoints.
"""
