"""``loss_ms_per_patch.train`` in the cells of the ``fine_tune`` configuration, which
report ``train_patches_per_s.fine_tune``: the same reader."""

from portbench import cells

read = cells.metric_reader("loss_ms_per_patch.train")
