// Flash attention, the segment-id and dropout bodies: flash_attention.cu
// built with FLASH_SEG=1, FLASH_DROP=1, as a library of its own so that
// the four variants compile in parallel (see that file).
#define FLASH_SEG 1
#define FLASH_DROP 1
#include "flash_attention.cu"
