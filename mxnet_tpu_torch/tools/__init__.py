"""The port's operational tools, run as modules:

- ``python -m mxnet_tpu_torch.tools.im2rec``: pack an image folder into
  RecordIO (``.lst``, ``.rec`` + ``.idx``) through
  ``mxnet_tpu_torch.recordio``; host only.
- ``python -m mxnet_tpu_torch.tools.bandwidth``: the kvstore push/pull
  sweep over array sizes, on the card (``--device cpu`` for the host),
  over the gang under ``python -m mxnet_tpu_torch.launch -n N``.
- ``python -m mxnet_tpu_torch.tools.chaos_check``: the robustness
  acceptance harness (modes ``train``, ``serve``, ``fleet``, ``llm``,
  ``elastic``, ``slo``, ``obs``, ``ckpt``), on the card
  (``--device cpu`` for the host).

The launcher is ``mxnet_tpu_torch.launch``.  Nothing here imports the
JAX package.
"""
