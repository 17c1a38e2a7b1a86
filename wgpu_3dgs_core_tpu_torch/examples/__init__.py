"""Examples of the torch port, the counterparts of the repo's
``examples/*.py``, each run as a module from the repo's root:

    python -m wgpu_3dgs_core_tpu_torch.examples.read_ply [model.ply]
    python -m wgpu_3dgs_core_tpu_torch.examples.write_ply [out.ply]
    python -m wgpu_3dgs_core_tpu_torch.examples.read_spz [model.spz]
    python -m wgpu_3dgs_core_tpu_torch.examples.write_spz [out.spz]
    python -m wgpu_3dgs_core_tpu_torch.examples.render_scene [scene] [out.npy]
    python -m wgpu_3dgs_core_tpu_torch.examples.fit_scene [--steps N]

Each runs on the card unless given ``--device cpu``. The readers default
to the repo's ``examples/model.ply`` and ``examples/model.spz`` and only
read them; the writers and the renderer write only to the path they are
given, or else into a temporary directory that is removed on exit.
"""
