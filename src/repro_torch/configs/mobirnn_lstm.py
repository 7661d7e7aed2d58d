"""The paper's own model: stacked LSTM for human activity recognition.

MobiRNN §4.1: 2 layers x 32 hidden units (default), input = 128 timesteps of
9-dim smartphone sensor readings, 6 activity classes (UCI HAR dataset shape).
Complexity sweeps in Figs 5/6 vary hidden in {32..256} and layers in {1..3}.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    name: str = "mobirnn-har"
    n_layers: int = 2
    hidden: int = 32
    input_dim: int = 9           # sensor channels
    seq_len: int = 128           # readings per window
    n_classes: int = 6           # activity labels
    dtype: str = "float32"

    def with_complexity(self, hidden: int, n_layers: int) -> "LSTMConfig":
        return dataclasses.replace(
            self, hidden=hidden, n_layers=n_layers,
            name=f"mobirnn-har-h{hidden}l{n_layers}")


CONFIG = LSTMConfig()
