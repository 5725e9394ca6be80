"""idle_in_port_pct: share of the program's `encoder:encode` spans' time
in which no operation ran on the card (torch.profiler's operations mapped
onto the spans' clock through the tracer's Unix / perf_counter pairs),
over the program stretch that follows a traced window
(portbench/progtrace.py). Nothing without a card."""

from portbench import progtrace


def read(run):
    r = progtrace.stretch(run)
    return None if r is None else r["idle_in_port_pct"]
