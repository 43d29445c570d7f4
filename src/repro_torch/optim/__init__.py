"""Optimizers of the port: AdamW (`adamw`) and int8 gradient compression
with error feedback (`grad_compress`), the counterparts of
`repro.optim`."""
