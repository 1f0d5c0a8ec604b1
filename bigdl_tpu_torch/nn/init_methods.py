"""Weight initialisation methods (the port of
``bigdl_tpu/nn/init_methods.py``, reference
``nn/InitializationMethod.scala``): ``Zeros``, ``Ones``,
``ConstInitMethod``, ``RandomUniform``, ``RandomNormal``, ``Xavier``,
``MsraFiller`` and ``BilinearFiller``.

Each is ``init(rng, shape, fan_in=None, fan_out=None, dtype=np.float32)``
over a numpy generator ``rng`` (the layers' ``init_arrays`` draw from one,
``nn.module.init_state_dict``) and returns a numpy array in the
reference's layout: the reference's distributions and fans, numpy's
numbers (weights carried from the reference go through ``convert``).
"""

from __future__ import annotations

import math

import numpy as np


class InitializationMethod:
    def init(self, rng, shape, fan_in=None, fan_out=None, dtype=np.float32):
        raise NotImplementedError


class Zeros(InitializationMethod):
    def init(self, rng, shape, fan_in=None, fan_out=None, dtype=np.float32):
        return np.zeros(shape, dtype)


class Ones(InitializationMethod):
    def init(self, rng, shape, fan_in=None, fan_out=None, dtype=np.float32):
        return np.ones(shape, dtype)


class ConstInitMethod(InitializationMethod):
    def __init__(self, value):
        self.value = value

    def init(self, rng, shape, fan_in=None, fan_out=None, dtype=np.float32):
        return np.full(shape, self.value, dtype)


class RandomUniform(InitializationMethod):
    """U(lower, upper); with no bounds, Torch-style +-1/sqrt(fan_in)."""

    def __init__(self, lower=None, upper=None):
        self.lower, self.upper = lower, upper

    def init(self, rng, shape, fan_in=None, fan_out=None, dtype=np.float32):
        if self.lower is None:
            bound = 1.0 / math.sqrt(max(fan_in or 1, 1))
            lo, hi = -bound, bound
        else:
            lo, hi = self.lower, self.upper
        return rng.uniform(lo, hi, shape).astype(dtype)


class RandomNormal(InitializationMethod):
    def __init__(self, mean=0.0, stdv=1.0):
        self.mean, self.stdv = mean, stdv

    def init(self, rng, shape, fan_in=None, fan_out=None, dtype=np.float32):
        return (self.mean + self.stdv
                * rng.standard_normal(shape)).astype(dtype)


class Xavier(InitializationMethod):
    """Glorot uniform: U(+-sqrt(6/(fan_in+fan_out)))."""

    def init(self, rng, shape, fan_in=None, fan_out=None, dtype=np.float32):
        bound = math.sqrt(6.0 / (max(fan_in or 1, 1) + max(fan_out or 1, 1)))
        return rng.uniform(-bound, bound, shape).astype(dtype)


class MsraFiller(InitializationMethod):
    """He/MSRA normal; ``variance_norm_average`` matches Caffe's AVERAGE."""

    def __init__(self, variance_norm_average=True):
        self.variance_norm_average = variance_norm_average

    def init(self, rng, shape, fan_in=None, fan_out=None, dtype=np.float32):
        if self.variance_norm_average:
            n = (max(fan_in or 1, 1) + max(fan_out or 1, 1)) / 2.0
        else:
            n = max(fan_in or 1, 1)
        return (math.sqrt(2.0 / n) * rng.standard_normal(shape)).astype(dtype)


class BilinearFiller(InitializationMethod):
    """Bilinear upsampling kernel for deconvolution, over the spatial dims
    ``shape[0]``, ``shape[1]`` of an HWIO weight, broadcast over the
    trailing (I, O)."""

    def init(self, rng, shape, fan_in=None, fan_out=None, dtype=np.float32):
        kh, kw = shape[0], shape[1]
        f_h, f_w = math.ceil(kh / 2.0), math.ceil(kw / 2.0)
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        ys = 1 - np.abs(np.arange(kh) / f_h - c_h)
        xs = 1 - np.abs(np.arange(kw) / f_w - c_w)
        kernel = np.outer(ys, xs).astype(dtype)
        return np.broadcast_to(
            kernel.reshape(kh, kw, *([1] * (len(shape) - 2))), shape).copy()


__all__ = ["BilinearFiller", "ConstInitMethod", "InitializationMethod",
           "MsraFiller", "Ones", "RandomNormal", "RandomUniform", "Xavier",
           "Zeros"]
