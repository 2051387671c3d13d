import numpy as np
import pytest

from ieache import params as P
from ieache.lwe import keygen, keygen_device


@pytest.mark.parametrize("pname", ["TEST_TINY", "TEST_SMALL_NOISY"])
def test_device_keygen_matches_host(pname):
    p = getattr(P, pname)
    host = keygen.generate_secret_keyset(p)
    dev = keygen_device.generate_secret_keyset_device(p)
    np.testing.assert_array_equal(dev.lwe_key.s, host.lwe_key.s)
    np.testing.assert_array_equal(
        dev.trlwe_key.coefs, host.trlwe_key.coefs
    )
    np.testing.assert_array_equal(dev.cloud.bk, host.cloud.bk)
    np.testing.assert_array_equal(dev.cloud.ks, host.cloud.ks)
