"""setup_s (s, end to end): from the process's start to the window's:
imports, the CUDA context, planting the inputs from the seed, and one
warm job on a few genomes (which builds the kernels in a checkout's
first run)."""


def read(ctx):
    return ctx["setup_s"]
