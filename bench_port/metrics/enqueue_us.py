"""enqueue_us: host microseconds a step in the program's launch span
(``f2d.launch``): the kernel library's lookup, the device guard, the
stream, the C call and its return code's check, from the program_spans
probe."""

from bench_port.program_trace import per_unit


def read(record):
    x = per_unit(record, lambda n: n == "f2d.launch", "total_s", "steps")
    return None if x is None else 1e6 * x
