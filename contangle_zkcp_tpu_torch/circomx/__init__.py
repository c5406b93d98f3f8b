from .r1cs_format import R1csFile, read_r1cs, write_r1cs
from .dummy import compile_dummy, dummy_signal_map, dummy_witness
from .wrapper import CircomBuilder, CircomCircuit, CircomConfig
