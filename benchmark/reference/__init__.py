"""The plain reference of a cell: the scene read back from its files and
the StyleMesh training step in plain PyTorch, float32 with TF32 off.

A frozen copy of the math of ``tests/torch_reference.py`` (the upstream
semantics) extended to the full step: a batch of views (the mean of their
losses), the Gram-average cache, the texture regularizer, Adam, the clamp
and the step-decayed learning rate. It imports nothing of
``stylemesh_tpu_torch`` and nothing of JAX, and takes nothing the program
made: it reads the scene's files and the style image itself and gets the
VGG weights the benchmark made.

``quant="fp8"`` is the control: the same step with the VGG trunk's input,
weights, activations and activation gradients and the Gram features rounded
to float8 e4m3 with a per-tensor scale, the precision below the bf16 the
configurations state.
"""
