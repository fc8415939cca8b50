"""d2h_MB_per_frame: the program's device-to-host byte counter over the
frames of the program_spans probe, in MB (1e6 bytes)."""


def read(record):
    rec = record.get("program_spans")
    if not rec or not rec.get("calls") or "d2h_bytes" not in rec:
        return None
    return rec["d2h_bytes"] / rec["calls"] / 1e6
