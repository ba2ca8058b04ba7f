"""Seconds per sample of the ``prior/inputs`` spans (synchronised): the
sample's images decoded and resized for SigLIP on the host, inside the
``prior`` span; their total over the number of ``prior`` spans. None
where the program opens no ``prior/*`` span."""


def read(ctx):
    priors = [name for name, a, b in ctx.spans if name == "prior"]
    if not priors or not any(name.startswith("prior/")
                             for name, a, b in ctx.spans):
        return None
    return sum(b - a for name, a, b in ctx.spans
               if name == "prior/inputs") / len(priors)
