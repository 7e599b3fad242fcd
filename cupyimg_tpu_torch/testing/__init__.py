"""Dual-backend test oracle: a test body run with ``xp=torch`` and with
``xp=numpy`` and the results compared (``helper``)."""

from cupyimg_tpu_torch.testing.helper import (  # noqa: F401
    numpy_torch_allclose,
    numpy_cupyimg_allclose,
    numpy_cupyimg_array_almost_equal,
    numpy_cupyimg_array_almost_equal_nulp,
    numpy_cupyimg_array_max_ulp,
    numpy_cupyimg_array_equal,
    numpy_cupyimg_array_list_equal,
    numpy_cupyimg_array_less,
    numpy_cupyimg_equal,
    numpy_cupyimg_raises,
    for_dtypes,
    product,
    assert_allclose,
)
