"""Milliseconds a request of the exchange between shards: the device time
of the gswap launches (the port's ``gswap_halves_kernel``, one a shard and
gswap, on the shard's card), the union on each card, averaged over the
run's cards."""

from collections import Counter

from benchmark.roofline import parse_kernel
from benchmark.tracing import union_us

KERNEL = "gswap_halves_kernel"


def card_ms(trace):
    """The gswap launches' union on each card, in ms, averaged over the
    run's cards; None where none ran."""
    # an event's card: the card whose own intervals hold its very times
    # (each interval taken once, should two cards hold the same times)
    cards = {dev: Counter(spans) for dev, spans in trace.cards.items()}
    mine: dict = {}
    for s, e, name, cat in trace.device:
        if cat != "kernel" or parse_kernel(name)[0] != KERNEL:
            continue
        for dev, spans in cards.items():
            if spans[(s, e)] > 0:
                spans[(s, e)] -= 1
                mine.setdefault(dev, []).append((s, min(e, trace.end)))
                break
    if not mine:
        return None
    return sum(union_us(v) for v in mine.values()) / 1e3 / trace.chips


def read(run):
    if not run.trace:
        return None
    ms = card_ms(run.trace)
    return None if ms is None else ms / len(run.requests)
