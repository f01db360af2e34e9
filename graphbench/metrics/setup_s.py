"""setup_s: from the process's start to the window's start: imports, the
CUDA context, the graph made on the device, its components, the sources,
the warm call (with BFS's auto probe and, in a fresh checkout, the kernels'
build)."""


def read(run):
    return run.setup_s
