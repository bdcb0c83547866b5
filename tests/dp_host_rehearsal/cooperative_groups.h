// Host stand-in: dp_dev.cuh of this directory needs nothing of it.
#pragma once
