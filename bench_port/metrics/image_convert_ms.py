"""image_convert_ms: milliseconds a frame in the program's span
``f2d.to_image.convert`` (the clip, scale and cast of the host frame to
8 bits), from the program_spans probe."""

from bench_port.program_trace import per_unit


def read(record):
    x = per_unit(record, lambda n: n == "f2d.to_image.convert", "total_s", "calls")
    return None if x is None else 1e3 * x
