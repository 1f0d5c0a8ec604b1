"""Recurrent cells and their time loops (the port of
``bigdl_tpu/nn/recurrent.py``, reference ``nn/Recurrent.scala:47``,
``nn/Cell.scala:48`` and the cells under ``nn/``).

The reference's ``lax.scan`` over the time axis is a Python loop over
autograd here: each step's output and state are new tensors, so the
backward runs through every step. Input layout (batch, time, ...), as
in the reference.

A cell has the reference's parameter names and layouts (``w_i`` (in, 4H),
``w_h`` (H, 4H), ``bias``; ``peep`` (3, H); the GRU's ``w_ic``, ``w_hc``,
``bias_c``), its gate order (``i, f, g, o`` from one product over the
input and one over the hidden state, the GRU's ``r, u``) and two hooks:

- ``init_hidden(x_t)``: the zero state for a first input ``x_t`` (its
  batch, type and device; a convolutional cell's spatial size ``ceil(s /
  stride)``);
- ``step(x_t, hidden)`` -> ``(out_t, new_hidden)``; ``hidden`` None is the
  zero state.

``forward([x_t, hidden])`` is the reference's single-step call on a
Table, returning ``[out_t, new_hidden]``. ``w_regularizer``,
``u_regularizer`` and ``b_regularizer`` penalise ``w_i``, ``w_h`` and
``bias`` and join the training loss as other layers' regularizers do
(``nn.module.regularization_loss``). ``p`` is the input dropout that
``Recurrent`` applies before the loop in training mode with a generator
(the reference's, with its rng).

The convolutional cells keep ``w_i``/``w_h`` as OIHW (OIDHW for the 3-D
cell; the reference's HWIO / DHWIO, ``jax_perms``) and pad SAME as XLA
does (``nn.conv.same_padding``, asymmetric above stride 1). A 2-D cell's
3x3 stride-1 convolutions run on the hand-written 3x3 kernels on the card
(``nn.conv.conv2d``), forward and input gradient; the others, and the 3-D
cell's, are ``F.conv2d`` / ``F.conv3d``, as the reference leaves them to
XLA.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.conv import conv2d, same_padding
from bigdl_tpu_torch.nn.init_methods import RandomUniform
from bigdl_tpu_torch.nn.module import Module, call_with_generator
from bigdl_tpu_torch.utils.device import resolve_device


def _param(shape, device, dtype, channels_last=False):
    t = torch.empty(shape, device=device, dtype=dtype)
    if channels_last:
        t = t.to(memory_format=torch.channels_last)
    return nn.Parameter(t)


def _dense(rng, shape, fan_in):
    return RandomUniform().init(rng, shape, fan_in=fan_in)


class Cell(Module):
    """Base recurrent cell (see module docstring)."""

    p = 0.0
    u_regularizer = None

    def regularized_leaves(self):
        return [("w_i", self.w_regularizer), ("w_h", self.u_regularizer),
                ("bias", self.b_regularizer)]

    def init_hidden(self, x_t):
        return x_t.new_zeros((x_t.shape[0], self.hidden_size))

    def step(self, x_t, hidden):
        raise NotImplementedError

    def forward(self, x):
        x_t, hidden = x
        out, new_h = self.step(x_t, hidden)
        return [out, new_h]

    def _regs(self, w, u, b):
        self.w_regularizer = w
        self.u_regularizer = u
        self.b_regularizer = b


class RnnCell(Cell):
    """h' = act(x W_i + h W_h + b) (reference ``nn/RnnCell.scala``)."""

    def __init__(self, input_size, hidden_size, activation=torch.tanh,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self._regs(w_regularizer, u_regularizer, b_regularizer)
        dev = resolve_device(device)
        self.w_i = _param((input_size, hidden_size), dev, dtype)
        self.w_h = _param((hidden_size, hidden_size), dev, dtype)
        self.bias = _param((hidden_size,), dev, dtype)

    def init_arrays(self, rng):
        return {"w_i": _dense(rng, (self.input_size, self.hidden_size),
                              self.input_size),
                "w_h": _dense(rng, (self.hidden_size, self.hidden_size),
                              self.hidden_size),
                "bias": np.zeros(self.hidden_size)}

    def step(self, x_t, h):
        if h is None:
            h = self.init_hidden(x_t)
        h2 = self.activation(x_t @ self.w_i + h @ self.w_h + self.bias)
        return h2, h2


class LSTM(Cell):
    """LSTM cell (reference ``nn/LSTM.scala``); hidden ``(h, c)``, gates
    ``i, f, g, o`` of ``x W_i + h W_h + b``."""

    def __init__(self, input_size, hidden_size, p=0.0, w_regularizer=None,
                 u_regularizer=None, b_regularizer=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.p = p
        self._regs(w_regularizer, u_regularizer, b_regularizer)
        dev = resolve_device(device)
        h = hidden_size
        self.w_i = _param((input_size, 4 * h), dev, dtype)
        self.w_h = _param((h, 4 * h), dev, dtype)
        self.bias = _param((4 * h,), dev, dtype)

    def init_arrays(self, rng):
        h = self.hidden_size
        return {"w_i": _dense(rng, (self.input_size, 4 * h),
                              self.input_size),
                "w_h": _dense(rng, (h, 4 * h), h),
                "bias": np.zeros(4 * h)}

    def init_hidden(self, x_t):
        h = super().init_hidden(x_t)
        return (h, h)

    def step(self, x_t, hidden):
        h, c = hidden if hidden is not None else self.init_hidden(x_t)
        z = x_t @ self.w_i + h @ self.w_h + self.bias
        i, f, g, o = z.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c2 = f * c + i * torch.tanh(g)
        h2 = o * torch.tanh(c2)
        return h2, (h2, c2)


class LSTMPeephole(LSTM):
    """LSTM with peephole connections ``peep`` (3, H) (reference
    ``nn/LSTMPeephole.scala``): ``i`` and ``f`` see ``c``, ``o`` sees
    the new ``c``."""

    def __init__(self, input_size, hidden_size, p=0.0, w_regularizer=None,
                 u_regularizer=None, b_regularizer=None, device=None,
                 dtype=torch.float32):
        super().__init__(input_size, hidden_size, p, w_regularizer,
                         u_regularizer, b_regularizer, device, dtype)
        self.peep = _param((3, hidden_size), self.w_i.device, dtype)

    def init_arrays(self, rng):
        out = super().init_arrays(rng)
        out["peep"] = _dense(rng, (3, self.hidden_size), self.hidden_size)
        return out

    def step(self, x_t, hidden):
        h, c = hidden if hidden is not None else self.init_hidden(x_t)
        z = x_t @ self.w_i + h @ self.w_h + self.bias
        i, f, g, o = z.chunk(4, dim=-1)
        p_i, p_f, p_o = self.peep
        i = torch.sigmoid(i + p_i * c)
        f = torch.sigmoid(f + p_f * c)
        c2 = f * c + i * torch.tanh(g)
        o = torch.sigmoid(o + p_o * c2)
        h2 = o * torch.tanh(c2)
        return h2, (h2, c2)


class GRU(Cell):
    """GRU cell (reference ``nn/GRU.scala``): gates ``r, u`` of ``x W_i +
    h W_h + b``, candidate ``tanh(x W_ic + (r h) W_hc + b_c)``."""

    def __init__(self, input_size, hidden_size, p=0.0, w_regularizer=None,
                 u_regularizer=None, b_regularizer=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.p = p
        self._regs(w_regularizer, u_regularizer, b_regularizer)
        dev = resolve_device(device)
        h = hidden_size
        self.w_i = _param((input_size, 2 * h), dev, dtype)
        self.w_h = _param((h, 2 * h), dev, dtype)
        self.bias = _param((2 * h,), dev, dtype)
        self.w_ic = _param((input_size, h), dev, dtype)
        self.w_hc = _param((h, h), dev, dtype)
        self.bias_c = _param((h,), dev, dtype)

    def init_arrays(self, rng):
        d, h = self.input_size, self.hidden_size
        return {"w_i": _dense(rng, (d, 2 * h), d),
                "w_h": _dense(rng, (h, 2 * h), h),
                "bias": np.zeros(2 * h),
                "w_ic": _dense(rng, (d, h), d),
                "w_hc": _dense(rng, (h, h), h),
                "bias_c": np.zeros(h)}

    def step(self, x_t, h):
        if h is None:
            h = self.init_hidden(x_t)
        z = x_t @ self.w_i + h @ self.w_h + self.bias
        r, u = z.chunk(2, dim=-1)
        r, u = torch.sigmoid(r), torch.sigmoid(u)
        cand = torch.tanh(x_t @ self.w_ic + (r * h) @ self.w_hc
                          + self.bias_c)
        h2 = (1.0 - u) * cand + u * h
        return h2, h2


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM over NCHW feature maps (reference
    ``nn/ConvLSTMPeephole.scala``): ``kernel_i`` convolves the input with
    ``stride``, ``kernel_c`` the hidden state at stride 1, both SAME; gates
    ``i, f, g, o`` along the channels."""

    jax_perms = {"w_i": (2, 3, 1, 0), "w_h": (2, 3, 1, 0)}
    rank = 2

    def __init__(self, input_size, output_size, kernel_i=3, kernel_c=3,
                 stride=1, padding=-1, with_peephole=True, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.kernel_i, self.kernel_c = kernel_i, kernel_c
        self.stride = stride
        self.with_peephole = with_peephole
        self.spatial = None        # bound by the first input (init_hidden)
        dev = resolve_device(device)
        r, o4 = self.rank, 4 * output_size
        cl = r == 2
        self.w_i = _param((o4, input_size) + (kernel_i,) * r, dev, dtype, cl)
        self.w_h = _param((o4, output_size) + (kernel_c,) * r, dev, dtype, cl)
        self.bias = _param((o4,), dev, dtype)
        if with_peephole:
            self.peep = _param((3, output_size), dev, dtype)
        else:
            self.register_parameter("peep", None)

    def init_arrays(self, rng):
        r, o4 = self.rank, 4 * self.output_size
        ki, kc = self.kernel_i, self.kernel_c
        w_i = _dense(rng, (ki,) * r + (self.input_size, o4),
                     ki ** r * self.input_size)
        w_h = _dense(rng, (kc,) * r + (self.output_size, o4),
                     kc ** r * self.output_size)
        to_port = (r + 1, r) + tuple(range(r))      # HWIO / DHWIO -> OI...
        out = {"w_i": w_i.transpose(to_port), "w_h": w_h.transpose(to_port),
               "bias": np.zeros(o4)}
        if self.with_peephole:
            out["peep"] = np.zeros((3, self.output_size))
        return out

    def init_hidden(self, x_t):
        # kept as the reference binds it at setup (its native records
        # carry the hidden state's spatial size)
        self.spatial = spatial = tuple(-(-s // self.stride)
                                       for s in x_t.shape[2:])
        h = x_t.new_zeros((x_t.shape[0], self.output_size) + spatial)
        return (h, h)

    def _conv(self, x, w, stride=1):
        k = w.shape[-1]
        pads = tuple(same_padding(s, k, stride) for s in x.shape[2:])
        return conv2d(x, w, (stride, stride), pads)

    def step(self, x_t, hidden):
        h, c = hidden if hidden is not None else self.init_hidden(x_t)
        bshape = (1, -1) + (1,) * self.rank
        z = (self._conv(x_t, self.w_i, self.stride) + self._conv(h, self.w_h)
             + self.bias.reshape(bshape))
        i, f, g, o = z.chunk(4, dim=1)
        if self.with_peephole:
            p_i, p_f, p_o = (p.reshape(bshape) for p in self.peep)
            i = torch.sigmoid(i + p_i * c)
            f = torch.sigmoid(f + p_f * c)
            c2 = f * c + i * torch.tanh(g)
            o = torch.sigmoid(o + p_o * c2)
        else:
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c2 = f * c + i * torch.tanh(g)
        h2 = o * torch.tanh(c2)
        return h2, (h2, c2)


class ConvLSTMPeephole3D(ConvLSTMPeephole):
    """Convolutional LSTM over NCDHW volumes (reference
    ``nn/ConvLSTMPeephole3D.scala``): the 2-D cell with ``F.conv3d``."""

    jax_perms = {"w_i": (2, 3, 4, 1, 0), "w_h": (2, 3, 4, 1, 0)}
    rank = 3

    def _conv(self, x, w, stride=1):
        k = w.shape[-1]
        pad = []
        for s in reversed(x.shape[2:]):           # F.pad: last axis first
            pad.extend(same_padding(s, k, stride))
        return F.conv3d(F.pad(x, pad), w, None, stride)


class MultiRNNCell(Cell):
    """Cells stacked at each time step (reference
    ``nn/MultiRNNCell.scala``); the hidden state is the tuple of theirs."""

    def __init__(self, cells):
        super().__init__()
        for i, c in enumerate(cells):
            self.add_module(str(i), c)
        last = list(self.children())[-1]
        self.hidden_size = getattr(last, "hidden_size", None)

    @property
    def cells(self):
        return list(self.children())

    def step(self, x_t, hidden):
        cells = self.cells
        hidden = hidden if hidden is not None else (None,) * len(cells)
        new_hidden = []
        out = x_t
        for c, h in zip(cells, hidden):
            out, h2 = c.step(out, h)
            new_hidden.append(h2)
        return out, tuple(new_hidden)


class Recurrent(Module):
    """A cell over (batch, time, ...), every step's output stacked on the
    time axis (reference ``nn/Recurrent.scala:47``)."""

    def __init__(self, cell=None):
        super().__init__()
        self.cell = cell

    def add(self, cell):
        self.cell = cell
        return self

    def forward(self, x, generator=None):
        p = getattr(self.cell, "p", 0.0)
        if self.training and p > 0.0 and generator is not None:
            # the reference's input dropout before the loop
            u = torch.empty(x.shape, device=x.device)
            keep = u.uniform_(generator=generator) < 1.0 - p
            x = torch.where(keep, x / (1.0 - p),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        h = None
        outs = []
        for t in range(x.shape[1]):
            out, h = self.cell.step(x[:, t], h)
            outs.append(out)
        return torch.stack(outs, dim=1)


class RecurrentDecoder(Recurrent):
    """Each output fed back as the next input for ``output_length`` steps
    (reference ``nn/RecurrentDecoder.scala``); the input is the first
    step's (batch, ...)."""

    def __init__(self, output_length, cell=None):
        super().__init__(cell)
        self.output_length = output_length

    def forward(self, x, generator=None):
        inp, h = x, None
        outs = []
        for _ in range(self.output_length):
            inp, h = self.cell.step(inp, h)
            outs.append(inp)
        return torch.stack(outs, dim=1)


class BiRecurrent(Module):
    """Bidirectional wrapper (reference ``nn/BiRecurrent.scala``): a
    ``Recurrent`` forward and one over the reversed time axis (a deep copy
    of the cell, its own weights), merged by ``"add"`` (default) or
    ``"concat"`` on the features. Dropout is not applied, as in the
    reference."""

    def __init__(self, merge="add", cell=None):
        super().__init__()
        self.merge = merge
        self.fwd = Recurrent(cell)
        self.bwd = Recurrent(copy.deepcopy(cell)) if cell is not None \
            else None

    def add(self, cell):
        self.fwd.add(cell)
        self.bwd = Recurrent(copy.deepcopy(cell))
        return self

    def forward(self, x):
        yf = self.fwd(x)
        yb = torch.flip(self.bwd(torch.flip(x, dims=(1,))), dims=(1,))
        if self.merge == "add":
            return yf + yb
        return torch.cat([yf, yb], dim=-1)


class TimeDistributed(Module):
    """An inner module applied at every time step (reference
    ``nn/TimeDistributed.scala``), as one call on (batch * time, ...)."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, x, generator=None):
        b, t = x.shape[0], x.shape[1]
        y = call_with_generator(self.module,
                                x.reshape((b * t,) + tuple(x.shape[2:])),
                                generator)
        return y.reshape((b, t) + tuple(y.shape[1:]))


__all__ = ["BiRecurrent", "Cell", "ConvLSTMPeephole", "ConvLSTMPeephole3D",
           "GRU", "LSTM", "LSTMPeephole", "MultiRNNCell", "Recurrent",
           "RecurrentDecoder", "RnnCell", "TimeDistributed"]
