"""Training of the port — the counterpart of `repro.train`: the train
state and step (`train_step`: `TrainConfig`, `init_train_state`,
`make_train_step`), checkpoints (`checkpoint`) and the loop with
restart and failure injection (`trainer`: `RunConfig`, `train`)."""
