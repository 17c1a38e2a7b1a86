"""The port's measurement tools, each runnable as
``python -m wgpu_3dgs_core_tpu_torch.tools.<name>``:

- ``probe_dyngrid``: K11, three ways to bound a grid by a count that lives
  on the device;
- ``bench_segsum``: K10, the segment sums (K5) stripped level by level;
- ``bench_kernel_variants``: K9, the forward rasterizer (K3) stripped
  level by level;
- ``grad_parity``: the render path's gradients against the brute-force
  reference at bench shape.

They run on the card unless given ``--device cpu``; the port bench is
``python -m wgpu_3dgs_core_tpu_torch.bench``. ``expand_tables`` makes the
segment tables K7's design finds hard, for the tests and chip_smoke.py.
"""
