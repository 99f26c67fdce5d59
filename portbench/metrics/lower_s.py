"""Host seconds of ``hakai_tpu_torch.lower()`` on the cell's deck (layer:
lowering)."""


def read(ctx):
    return ctx["lower_s"]
