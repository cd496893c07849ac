"""Command-line tools beside the package's verbs (ports of the JAX
package's `tools/`): `synthetic_fit` (learning evidence on the
procedural dataset), `ledger_diff` (the executable ledger's drift
gate), `elastic_drill`, `halo_grad_repro` and `serve_bench` (the
headless serving benchmark's engine modes). Run each as
`python -m deepof_tpu_torch.tools.<name>`."""
