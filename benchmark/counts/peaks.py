"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W): what the roofline and MFU shares divide by."""

TF32_FLOPS = 495e12      # tensor cores, TF32: the network products
BF16_FLOPS = 989e12      # tensor cores, bf16
FP32_FLOPS = 67e12       # CUDA cores, fp32 FMA code (the compositors)
HBM_BYTES = 3.35e12      # HBM3 bandwidth, bytes/s
