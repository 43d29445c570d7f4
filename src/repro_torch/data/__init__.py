"""The training input pipeline of the port (`pipeline`), the counterpart
of `repro.data`."""
