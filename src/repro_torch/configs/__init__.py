from repro_torch.configs import mobirnn_lstm

MOBIRNN_LSTM = mobirnn_lstm.CONFIG

__all__ = ["MOBIRNN_LSTM", "mobirnn_lstm"]
