"""The port's kernels and the plain PyTorch ops around them. Importing the
package registers the kernels as ``comet::`` operators (``library.py``)."""

from . import library  # noqa: F401
