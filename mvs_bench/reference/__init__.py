"""The plain float32 references that decide a run's `correct`: one module
per configuration (named by its file's "reference" key), on the shared
blocks of `common.py`. They import torch and numpy only: nothing of the
system under test."""
