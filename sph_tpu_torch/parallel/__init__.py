"""Multi-process engines over ``torch.distributed`` (counterpart of
``sph_tpu/parallel/``): ``group`` starts and joins the ranks and moves
rows between them, ``domain`` is the gather-parallel all-pairs engine,
``slabs`` the z-slab engine on the cell engine's kernels, ``dryrun`` the
multi-rank dry run and ``run`` the rank program that runs saved states."""
