"""stash_peak_units: the most stash units one stage held at once in the
last traced step, from the executor's live store
(``StepResult.stats.peak_local``)."""


def read(ctx):
    if ctx.stats is None or not ctx.stats.peak_local:
        return None
    return float(max(ctx.stats.peak_local.values()))
