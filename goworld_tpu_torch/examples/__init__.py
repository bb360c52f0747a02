"""Example games of the port, each the twin of one under the repository's
``examples/`` (same entities, RPCs and configs, over ``goworld_tpu_torch``),
and the strict bot client ``test_client``."""
