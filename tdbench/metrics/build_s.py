"""build_s: seconds of the host build of the BLCO tensor, the sum of the
phases ``BLCOTensor.construction_stats`` times (``core/tensor``,
``core/linearize``, ``core/blco``); moves ``setup_s``."""


def read(run):
    build = run["build"]
    return float(sum(build.values())) if build else None
