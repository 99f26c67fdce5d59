"""Measurement probes of the port, run as modules
(``python -m hakai_tpu_torch.probes.dma``), and the card's peak rates
that their bounds (and ``chip_smoke.py``'s) divide by."""

# H100 SXM peaks (NVIDIA data sheet, dense, no tensor cores): device
# memory 3.35 TB/s; 67 TFLOP/s float32, 34 TFLOP/s float64
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "mixed": 67e12}
