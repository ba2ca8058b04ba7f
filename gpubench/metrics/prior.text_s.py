"""Seconds per sample of the ``prior/text`` spans (synchronised): the
prompt tokenized and encoded by T5-XXL and CLIP-L, inside the ``prior``
span; their total over the number of ``prior`` spans, so a sample whose
prompt came from the prompt cache counts 0. None where the program opens
no ``prior/*`` span."""


def read(ctx):
    priors = [name for name, a, b in ctx.spans if name == "prior"]
    if not priors or not any(name.startswith("prior/")
                             for name, a, b in ctx.spans):
        return None
    return sum(b - a for name, a, b in ctx.spans
               if name == "prior/text") / len(priors)
