"""Command-line entry points (`repro.launch`): ``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve`` and ``python -m repro_torch.launch.dryrun``
(the step of every arch × shape traced on the meta device; its operation
counter is `launch.op_analysis`), and `launch.lanes.run_lanes`, which starts
the ranks of a lane-sharded run.

What has no torch counterpart, and why:

* ``repro/launch/mesh.py`` and ``repro/launch/shardings.py``: the XLA device
  mesh and its logical-axis partition rules.  The port runs a model step on
  one card; its only multi-rank layouts are the replay's lanes and scenario
  shards over a `torch.distributed` process group (`core.engine_scan`).
* ``repro/launch/hlo_analysis.py``'s HLO text and its collective bytes: the
  port has no compiled HLO; `launch.op_analysis` counts FLOPs and bytes at
  aten-operation boundaries instead, and a step on one card has no
  collectives.
* ``repro/kernels/autotune.py``: the Pallas column-tile table.  The CUDA
  K2 and K6 take any row width P at one design
  (``kernels/csrc/weighted_update.cu``, ``kernels/ops.py``), so there is
  no tile to tune.
"""
