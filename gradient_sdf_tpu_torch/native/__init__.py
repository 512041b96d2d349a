"""Host-side C code of the port: the PNG row unfilter (`png_unfilter.c`)
and the baseline JPEG decoder (`jpeg_decode.c`), built at first use by
`_build.load` and bound with ctypes in `data/png.py` and `data/jpeg.py`."""
