"""From process start to the first timed op: imports, the CUDA context,
the port's libraries, the state, the load phase and the warm sweeps."""


def read(run):
    return run.setup_s
