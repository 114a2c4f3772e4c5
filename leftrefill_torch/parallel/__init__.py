"""Data and context parallelism on ``torch.distributed`` (counterpart of
``leftrefill_tpu/parallel``): one process per rank, started by ``torchrun``
(``python -m torch.distributed.run``), where JAX has one controller over a
device mesh.

- ``mesh``: the rank's place (``init_from_env``), the backend rule, the
  groups of a (data, view) layout and the collectives every other module
  goes through;
- ``batch``: the CFG-doubled UNet batch split over a group's ranks
  (``batch_parallel_apply``), the serving latency mode;
- ``context``: the multi-view joint self-attention with the views split
  over a group, K and V gathered (``make_context_parallel_attn``)."""
