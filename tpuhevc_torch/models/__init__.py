"""The NN-FME MLP on torch (inference), weights in tpuhevc's numpy layout."""
