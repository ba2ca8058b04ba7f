"""Seconds per sample of the stage's ``prior`` span (synchronised):
SigLIP inputs decoded and resized on the host, the T5 and CLIP-L prompt
encode, SigLIP and Redux on the card."""


def read(ctx):
    spans = [b - a for name, a, b in ctx.spans if name == "prior"]
    return sum(spans) / len(spans) if spans else None
