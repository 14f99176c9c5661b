"""The repository's example programs on the port, one module each, run as

    python -m comms_tpu_torch.examples.<name> [arguments] [--device cpu]

Each is the counterpart of ``examples/<name>.py`` of the JAX package:
``main(argv=None)`` parses the same arguments plus ``--device`` (default
``cuda``: the card unless the caller asks for the CPU) and returns what
it printed as a value.  Importing a module runs nothing.
"""
