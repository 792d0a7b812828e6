"""``sht_setup_s``: seconds of the SHT operator's one-time builds in the run,
the union of the intervals that ``cora_tpu_torch.util.profiling.builds``
records as ``sht_geometry`` (the host ring geometry), ``checkpoints`` (the
scan recurrence's checkpoint rows) and ``lambda_build`` (the cached Λ).
The builds nest (the device Λ build reads the rows), so they are counted
once.  None where the program records no builds."""

from harness import stats

NAMES = ("sht_geometry", "checkpoints", "lambda_build")


def read(ctx):
    from cora_tpu_torch.util import profiling

    spans = [(s, e) for n, s, e in getattr(profiling, "builds", ()) if n in NAMES]
    if not spans:
        return None
    return stats.union_length(spans)
