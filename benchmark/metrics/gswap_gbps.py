"""Gigabytes (10^9 bytes) a second that a card pulls from its partner's
card in the gswaps: the program's ``gswap_peer_bytes`` counter a request,
over the run's cards, divided by the gswap launches' device time a card
(``gswap_ms``).  The exchange's achieved bandwidth on the link; None where
no bytes crossed between cards."""

from benchmark import program_spans
from benchmark.metrics import gswap_ms


def read(run):
    totals = program_spans.counter_totals(run)
    if totals is None or not totals.get("gswap_peer_bytes"):
        return None
    trace = getattr(run, "trace", None)
    ms = gswap_ms.card_ms(trace) if trace else None
    if not ms:
        return None
    return totals["gswap_peer_bytes"] / trace.chips / (ms * 1e6)
