"""Sharded pipelines over ``torch.distributed`` (counterparts of
:mod:`ska_pst_dsp_tpu.parallel`).

* :mod:`.sharded` — the mesh, halo exchanges, :func:`.sharded.reshard`, and
  the time-sharded analysis, inversion and round trips;
* :mod:`.corner_turn` — the ('chan', 'time') mesh and the all-to-all
  corner-turn inversion;
* :mod:`.two_stage_sharded` — LowCBF and the two-stage cascades, sharded;
* :mod:`.distributed` — process-group set-up, per-rank DADA ingest, and
  :func:`.distributed.spawn`, which runs a function on every rank of a
  local process group.
"""
