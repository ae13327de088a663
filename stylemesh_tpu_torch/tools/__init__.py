"""Host-side command-line tools (counterparts of the repository's
``tools/convert_vgg.py``, ``tools/convert_lpips.py`` and
``tools/make_demo_scene.py``), each run as ``python -m
stylemesh_tpu_torch.tools.<name>``."""
