"""step_self_us: host microseconds a step in the program's step span
(``f2d.step``) outside its phase wrappers' spans: the Python step body
(dispatch, the pressure chain, the state's replace, the step counter's
add), from the program_spans probe."""

from bench_port.program_trace import per_unit


def read(record):
    x = per_unit(record, lambda n: n == "f2d.step", "self_s", "steps")
    return None if x is None else 1e6 * x
