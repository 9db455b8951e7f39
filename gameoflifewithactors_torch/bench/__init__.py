"""The bench package: the port's measuring harness and its tools.

Counterparts of the repository's ``bench.py`` and of six of its scripts,
each run as ``python -m gameoflifewithactors_torch.bench[.<tool>]``. The
measuring ones take ``--device {cuda,cpu}`` (default the card; without
one they exit non-zero before measuring) and print one JSON record per
measurement, stamped with the card's name and power limit and with the
provenance of the measured tree (``utils/provenance.head_stamp``):

- :mod:`.run` (``python -m gameoflifewithactors_torch.bench``): the
  main path's cell-updates/s, ``bench.py``'s protocol and last line, the
  store ``results/cuda_best.json`` and its ``--report``;
- :mod:`.config5`: BASELINE.json config #5 (a Gosper gun in a 65536²
  field) on the sparse, paged and kernel engines;
- :mod:`.weak_scaling`: a fixed tile per mesh position, growing position
  counts, with the COST fields read from the store;
- :mod:`.warm_vs_cold`: a cold and a warm process per spec against one
  kernel build cache root, and the CLI's time to first step.

The record readers touch no device and take no ``--device``:

- :mod:`.gate`: a fresh record against a baseline with tolerance bands
  (``obs/diff.py``), exit 1 on a regression;
- :mod:`.history`: the port's records folded into
  ``results/history_cuda.jsonl`` with median/MAD anomaly flags;
- :mod:`.roofline_report`: the measured roofline section of a RunReport
  (device busy time, duty cycle, in-kernel rate, top device slices,
  counted work).

:mod:`.timing` holds the timing helpers (CUDA events, a tick closed by a
device sync, the card's name and power limit) that ``chip_smoke.py``
imports. Nothing here imports JAX or the JAX package; ``torch`` is
imported inside the calls that measure.
"""
