"""``scan_setup_s``: seconds of a scan-mode SHT operator's one-time builds in
the run, the union of the intervals that ``cora_tpu_torch.util.profiling.
builds`` records as ``sht_geometry`` (the host ring geometry and recurrence
tables), ``checkpoints`` (checkpoint rows of a float32 recurrence, where a
program builds them) and ``scan_tables`` (the recurrence's and the ring
stage's tables put on the device).  Builds that nest are counted once.
None where the program records none of them."""

from harness import stats

NAMES = ("sht_geometry", "checkpoints", "scan_tables")


def read(ctx):
    from cora_tpu_torch.util import profiling

    spans = [(s, e) for n, s, e in getattr(profiling, "builds", ()) if n in NAMES]
    if not spans:
        return None
    return stats.union_length(spans)
