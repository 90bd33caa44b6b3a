"""Command-line entry points (`repro.launch`): ``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve`` and ``python -m repro_torch.launch.dryrun``
(the step of every arch × shape traced on the meta device, on one card or
on the production meshes; its operation counter is `launch.op_analysis`),
`launch.lanes.run_lanes`, which starts the ranks of a multi-rank run, and
the model's partition over a device mesh: `launch.mesh` (the production
and debug meshes as a `torch.distributed` `DeviceMesh`) and
`launch.shardings` (the reference's logical-axis rules as DTensor
placements, the activation hints, the parameters' distribution).

What has no torch counterpart, and why:

* ``repro/launch/hlo_analysis.py``'s HLO text: the port has no compiled
  HLO; `launch.op_analysis` counts FLOPs and bytes at aten-operation
  boundaries instead, and on a mesh the rank's local operations and the
  bytes of the collectives DTensor issues.
* ``repro/kernels/autotune.py``: the Pallas column-tile table.  The CUDA
  K2 and K6 take any row width P at one design
  (``kernels/csrc/weighted_update.cu``, ``kernels/ops.py``), so there is
  no tile to tune.
"""
