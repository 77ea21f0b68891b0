"""Data-parallel scale-out over ``torch.distributed``.

The reference has no parallelism (SURVEY.md section 2.3).  Here, as in the
JAX package's ``parallel/`` over a ``jax.sharding.Mesh``, document rows are
sharded over the ranks of a process group (one process per GPU, NCCL; gloo
on the CPU), the encode tables are copied once to every rank's device, and
the byte / token / overflow counters are all-reduced.  Every rank of the
group makes the same calls with the same inputs (SPMD), and each rank does
the host work of its own rows.
"""
