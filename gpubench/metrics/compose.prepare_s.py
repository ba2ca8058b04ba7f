"""Seconds per sample of stage 4's ``prepare`` span (synchronised): the
resolution policy's resize, the /16 alignment, the boxes scaled, the
keep mask and the bucketing, on the host before the prior."""


def read(ctx):
    spans = [b - a for name, a, b in ctx.spans if name == "prepare"]
    return sum(spans) / len(spans) if spans else None
