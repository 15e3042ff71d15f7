"""The JAX package's four ``examples/*.py`` scripts as entry points of the
port, one module each:

* ``quickstart`` -- ADMM block pruning of one matrix -> PBCSR -> matrix
  reorder -> the block-sparse kernel;
* ``prune_style_transfer`` -- the style-transfer app unpruned, pruned, and
  pruned + compiled (Table 1's three variants);
* ``serve_pruned_lm`` -- a pruned qwen-family LM served by the ``Engine``
  and its continuous-batching ``RequestScheduler``;
* ``train_lm_100m`` -- a ~100M-parameter LM trained with ADMM pruning,
  checkpoints and preemption handling.

Each runs as ``python -m repro_torch.examples.<name> [--device cpu]`` (on
``cuda`` by default; without a GPU it raises) and has ``main(argv=None) ->
dict``, which returns the numbers it prints.  Its stages are plain
functions of tensors.  Draws come from numpy seeds, because ``jax.random``
draws cannot be reproduced in torch: the printed values differ from the
JAX scripts', the labels of the printed lines are the same.
"""
