"""Host seconds around ``Adjacency.from_csr``, synchronized on both sides."""


def read(run):
    return run["graph_build_s"]
