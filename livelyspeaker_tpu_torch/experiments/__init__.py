"""Experiments kept beside the package proper (the JAX package's root
``experiments/``): ``distillation``, progressive distillation of the RAG."""
