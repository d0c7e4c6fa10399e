"""Host preprocessing and uploads: host clock around
``repro_torch.open(...)`` and the first solve or first query, which
builds the lazy device layouts (B1's gather order, the packed streams)
and loads the kernel library."""


def read(run):
    return run.prep_s
