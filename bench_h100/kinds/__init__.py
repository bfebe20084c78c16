"""Generators and drivers of the traffic kinds, one module each, named by
a mix's `kind`: `closed_loop` (clients of the OpenAI HTTP surface) and
`train_batches` (the training step)."""
