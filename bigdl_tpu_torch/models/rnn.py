"""Recurrent language models (the port of ``bigdl_tpu/models/rnn.py``):
``SimpleRNN`` (reference ``models/rnn/SimpleRNN.scala``: LookupTable ->
Recurrent(RnnCell) -> TimeDistributed(Linear) -> LogSoftMax) and the PTB
LSTM language model of ``example/languagemodel/PTBModel.scala``, with the
reference's defaults. Both return log-probabilities (batch, time, vocab)
of token ids (batch, time); their weights start empty: call
``reset(seed)`` or load a ``state_dict``."""

from __future__ import annotations

from bigdl_tpu_torch.nn import (LSTM, Linear, LogSoftMax, LookupTable,
                                MultiRNNCell, Recurrent, RnnCell,
                                Sequential, TimeDistributed)


def SimpleRNN(input_size=4000, hidden_size=40, output_size=4000,
              device=None):
    return (Sequential()
            .add(LookupTable(input_size, hidden_size, device=device))
            .add(Recurrent(RnnCell(hidden_size, hidden_size, device=device)))
            .add(TimeDistributed(Linear(hidden_size, output_size,
                                        device=device)))
            .add(LogSoftMax()))


def PTBModel(input_size=10000, hidden_size=256, output_size=10000,
             num_layers=2, keep_prob=1.0, device=None):
    cells = [LSTM(hidden_size, hidden_size, device=device)
             for _ in range(num_layers)]
    return (Sequential()
            .add(LookupTable(input_size, hidden_size, device=device))
            .add(Recurrent(MultiRNNCell(cells)))
            .add(TimeDistributed(Linear(hidden_size, output_size,
                                        device=device)))
            .add(LogSoftMax()))


__all__ = ["PTBModel", "SimpleRNN"]
