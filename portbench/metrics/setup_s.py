"""Set-up: from the process's start to the window's, with the imports,
the CUDA context, the weights, the packing, the library's build or load
and the warm-up of the cell's own shapes (host clock)."""


def read(s):
    return s.setup_s
