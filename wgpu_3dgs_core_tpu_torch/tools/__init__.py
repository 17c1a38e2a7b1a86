"""The port's measurement tools, each runnable as
``python -m wgpu_3dgs_core_tpu_torch.tools.<name>``:

- ``probe_dyngrid``: K11, three ways to bound a grid by a count that lives
  on the device;
- ``bench_segsum``: K10, the segment sums (K5) stripped level by level;
- ``bench_kernel_variants``: K9, the forward rasterizer (K3) stripped
  level by level;
- ``grad_parity``: the render path's gradients against the brute-force
  reference at bench shape;
- ``profile_components``: the training step by stage (its forward's
  prefixes, K3 and K4 alone, the backward's tail and N-scale autograd)
  by device time, operations and the host's enqueue;
- ``bench_bin``: the binning chain by stage;
- ``bench_bwd``: the backward's work outside K4 (the tail, the N-scale
  autograd, the tail's sub-pieces);
- ``bench_nscale``: the N-scale autograd by piece;
- ``bench_sort_shapes``: what a sort with payloads charges for keys,
  stability, payload rows and length (cases A-I);
- ``bench_irregular_ops``: eleven fragment-scale irregular ops (sorts,
  scatters, gathers, a running max, ``searchsorted``);
- ``bench_reorder``: the sort carrying payloads against the row gather
  after it;
- ``bench_reorder2``: block gather, unique scatter, segment sum, an
  N-scale argsort and a cumsum;
- ``scaling_efficiency``: the sharded step's strong-scaling efficiency
  t(1) / (D t(D)), the D = 8 route build and the D = 1 overhead against
  ``render``.

The first four run on the card unless given ``--device cpu``; the next
eight share ``stages`` and read on the card only, the last four on
numpy draws of the JAX tools (``tools/<name>.py``) made in the tool;
``scaling_efficiency`` runs NCCL ranks one a card, or gloo ranks on the
CPU with ``--device cpu``. The port bench is
``python -m wgpu_3dgs_core_tpu_torch.bench``. ``expand_tables`` makes the
segment tables K7's design finds hard, for the tests and chip_smoke.py.
"""
