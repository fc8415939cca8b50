"""image_d2h_ms: milliseconds a frame in the program's span
``f2d.to_image.d2h`` (the wait for the launch queue and the frame's
device-to-host copy), from the program_spans probe."""

from bench_port.program_trace import per_unit


def read(record):
    x = per_unit(record, lambda n: n == "f2d.to_image.d2h", "total_s", "calls")
    return None if x is None else 1e3 * x
