"""The kernels of the port and their plain versions."""


def kernel_wrappers():
    """{kernel name: its CUDA wrapper}. Each wrapper adds one to its
    `launches` where it launches its kernel, and nowhere else."""
    from fancyrec_tpu_torch.ops.brand_dropout import (
        aspect_dropout_bwd_cuda, aspect_dropout_fwd_cuda)
    from fancyrec_tpu_torch.ops.gru_scan import (
        gru_scan_bwd_cuda, gru_scan_cuda)
    from fancyrec_tpu_torch.ops.moe import moe_rows_cuda, moe_wgrad_cuda
    from fancyrec_tpu_torch.ops.similarity import (
        cosine_scores_cuda, topk_int8_cuda)
    return {"gru_scan": gru_scan_cuda, "topk_int8": topk_int8_cuda,
            "gru_scan_bwd": gru_scan_bwd_cuda,
            "aspect_dropout_fwd": aspect_dropout_fwd_cuda,
            "aspect_dropout_bwd": aspect_dropout_bwd_cuda,
            "cosine_scores": cosine_scores_cuda,
            "moe_rows": moe_rows_cuda, "moe_wgrad": moe_wgrad_cuda}
