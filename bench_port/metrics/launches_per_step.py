"""launches_per_step: the program's launch counter (every kernel-library
entry point enqueued) over the steps of the program_spans probe."""


def read(record):
    rec = record.get("program_spans")
    if not rec or not rec.get("steps") or "launches" not in rec:
        return None
    return sum(rec["launches"].values()) / rec["steps"]
