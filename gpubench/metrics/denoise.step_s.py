"""Seconds per denoise step of the window: the pipeline's ``step`` spans
(synchronised), their total over their count."""


def read(ctx):
    spans = [b - a for name, a, b in ctx.spans if name == "step"]
    return sum(spans) / len(spans) if spans else None
