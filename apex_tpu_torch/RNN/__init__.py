"""apex.RNN analog (reference: ``apex/RNN/models.py:19-54``)."""
from .rnn import (GRU, LSTM, RNNContainer, ReLU, Tanh, gru_cell, lstm_cell,
                  mLSTM, mlstm_cell, rnn_params_from_jax, rnn_relu_cell,
                  rnn_tanh_cell)

__all__ = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM", "RNNContainer",
           "lstm_cell", "gru_cell", "rnn_relu_cell", "rnn_tanh_cell",
           "mlstm_cell", "rnn_params_from_jax"]
