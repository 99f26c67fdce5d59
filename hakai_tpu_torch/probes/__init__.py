"""Measurement probes of the port, run as modules
(``python -m hakai_tpu_torch.probes.dma``)."""
