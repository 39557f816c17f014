"""The benchmark harness of the PyTorch/CUDA port: the manifest and its
files found by name (``manifest``), one run of a cell (``cell``), the
trace arithmetic (``trace``), the frozen roofline accounting
(``roofline``), the comparison that decides ``correct`` (``check``) and
its plain reference (``reference``, ``walk``)."""
