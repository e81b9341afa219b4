"""The model families ported so far: the dense encoder (router and
library experts) and the xLSTM family of the zoo (mLSTM and sLSTM
cells).  Config, layers, attention, ssm, blocks, model."""
