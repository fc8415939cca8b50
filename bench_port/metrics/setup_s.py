"""setup_s: process start to window start (imports, the kernel library's
load or build, the scene, the seeded state, the first call and the warm-up)."""


def read(record):
    return record.get("setup_s")
