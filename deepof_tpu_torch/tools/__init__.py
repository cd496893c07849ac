"""Command-line tools beside the package's verbs (ports of the JAX
package's `tools/`): `synthetic_fit` (learning evidence on the
procedural dataset), `ledger_diff` (the executable ledger's drift
gate), `elastic_drill`, `halo_grad_repro`, `serve_bench` (the serving
benchmark: its engine modes in-process, its process modes over a
fleet) and `autoscale_drill`. Run each as
`python -m deepof_tpu_torch.tools.<name>`."""
