"""Host C++ of the port, built with g++ at first use and bound with ctypes:
the entropy half of the hybrid JPEG decode (``jpeg_coef.cpp``, ``image.py``)."""
