"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

FP32_FLOPS = 67e12      # float32 outside the tensor cores
TF32_FLOPS = 495e12     # TF32 on the tensor cores
HBM_BYTES = 3.35e12     # HBM3 bytes per second


def flops_peak() -> float:
    """The float32 peak the run can reach: the TF32 tensor-core rate where
    the process has TF32 on for float32 products, else plain float32."""
    import torch
    tf32 = (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32)
    return TF32_FLOPS if tf32 else FP32_FLOPS


def bound_s(flops: float, nbytes: float, peak_flops: float = FP32_FLOPS
            ) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the peak bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
