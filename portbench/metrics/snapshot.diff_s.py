"""snapshot.diff_s: per build, the program's ``commit.diff`` spans: each
layer's diff against the build's tree (the copy-op diff over a COPY's
sources, or the scan's walk after a RUN), per-file Python before the
tar write."""

from portbench.metrics._program import span_s


def read(run):
    return span_s(run, "commit.diff")
