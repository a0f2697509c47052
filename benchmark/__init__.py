"""The benchmark of ``oadp_torch``, the PyTorch and CUDA port of OADP.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell names a configuration
(``configs/<config>.json``) and a traffic mix (``mixes/<mix>.json``, data
that names its job, ``jobs/<job>.py``), and its limits on the numbers
compared are ``limits/<cell>.json``; each metric is a reader in
``metrics/<metric>.py``. The plain reference that decides ``correct``
lives in ``reference/`` and imports nothing of the port.
"""
