"""setup_s: seconds from the run's first line to the window's start
(imports, the weights drawn on the device, the engine, the warm-up; the
first run in a checkout also builds the CUDA kernels). Host clock."""


def read(run):
    return run.setup_s
