"""From process start to the first timed step: CUDA init, loading the
built kernels, the graph and inputs, ``Adjacency.from_csr``, the model and
the warm-up steps."""


def read(run):
    return run["setup_s"]
