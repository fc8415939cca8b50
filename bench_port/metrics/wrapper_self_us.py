"""wrapper_self_us: host microseconds a step in the program's phase
wrapper spans (``f2d.phase.*``) outside their launches: the operand
checks and the output allocations, from the program_spans probe."""

from bench_port.program_trace import per_unit


def read(record):
    x = per_unit(record, lambda n: n.startswith("f2d.phase."), "self_s", "steps")
    return None if x is None else 1e6 * x
