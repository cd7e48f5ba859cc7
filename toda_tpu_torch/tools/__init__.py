"""The port's command-line entry points, the counterparts of the JAX
package's ``tools/*.py``: each module has ``main(argv=None)`` and runs as
``python -m toda_tpu_torch.tools.<name>``. ``scripts/run_toda.sh`` runs the
TODA recipe through them."""
