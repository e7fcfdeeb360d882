"""The device's idle time inside CVP-MVSNet's cascade a request."""

NAME = "cvp_level_idle_ms.serve"
UNIT = "ms"
LAYER = "Models"
MOVES = "maps_per_s"
#: the prefix of the program's CVP-MVSNet spans (features, and each
#: level's hypotheses, sweep, regularize and regress)
PREFIX = "wildmvs_torch.cvp_mvsnet."


def read(trace):
    """The idle gaps that the trace names by a span of PREFIX, summed over
    the traced requests, in ms a request. A gap is named by the innermost
    host record at its middle (trace.py), so this counts only the gaps in
    which the span itself was innermost: host Python between the
    cascade's operators, not a gap under an operator called inside the
    span. None where no gap carries such a name (a program without the
    spans)."""
    gaps = [s for label, s in trace.idle_gaps.items()
            if label.startswith(PREFIX)]
    if not gaps or trace.units <= 0:
        return None
    return 1e3 * sum(gaps) / trace.units
