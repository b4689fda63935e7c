"""Data: the int16 waveform quantisation shared by corpus banks (``hdf5``)."""
