"""Seconds per sample of the ``prior/image`` spans (synchronised): the
SigLIP inputs copied to the card and run through SigLIP and Redux,
inside the ``prior`` span; their total over the number of ``prior``
spans. None where the program opens no ``prior/*`` span."""


def read(ctx):
    priors = [name for name, a, b in ctx.spans if name == "prior"]
    if not priors or not any(name.startswith("prior/")
                             for name, a, b in ctx.spans):
        return None
    return sum(b - a for name, a, b in ctx.spans
               if name == "prior/image") / len(priors)
