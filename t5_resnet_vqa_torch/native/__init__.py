"""The host's native image resize (``preproc.cpp``, built with g++ at first
use and loaded with ctypes by ``loader.py``)."""
