"""The host's syncs with the card (the program's counted blocking copies:
``leftrefill_torch.trace``) in the traced window's train steps, per step."""

from benchmark.spans import syncs_per_unit


def read(name, ctx):
    if ctx["kind"] != "train":
        return None
    return syncs_per_unit(ctx)
