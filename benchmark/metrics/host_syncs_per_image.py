"""The host's syncs with the card (the program's counted blocking copies:
``leftrefill_torch.trace``) in the traced window's units, per image
returned."""

from benchmark.spans import syncs_per_unit


def read(name, ctx):
    if ctx["kind"] != "infer":
        return None
    per_unit = syncs_per_unit(ctx)
    return None if per_unit is None else per_unit / ctx["per_unit"]
