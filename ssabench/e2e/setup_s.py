"""setup_s: from process start to the first timed call (data from the seed,
the port's set-up and upload, kernels loaded or built, the warm-up)."""


def read(run):
    return run.setup_s
