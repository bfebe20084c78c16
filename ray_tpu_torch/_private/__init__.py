"""Internals of the port: kernel build and launch, device selection and
runtime flags."""
