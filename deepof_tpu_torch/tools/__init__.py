"""Command-line tools beside the package's verbs (ports of the JAX
package's `tools/`): `synthetic_fit` (learning evidence on the
procedural dataset) and `ledger_diff` (the executable ledger's drift
gate). Run each as `python -m deepof_tpu_torch.tools.<name>`."""
