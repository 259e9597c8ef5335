// The four zlib calls the host libraries use.  Where the zlib headers are
// installed they are included; elsewhere (a host with the shared library
// but no development headers) the calls are declared here with zlib's
// own signatures, and the libraries link libz.so.1 by name either way.

#pragma once

#if __has_include(<zlib.h>)
#include <zlib.h>
#else
extern "C" {
typedef struct gzFile_s *gzFile;
gzFile gzopen(const char *path, const char *mode);
int gzbuffer(gzFile file, unsigned size);
int gzread(gzFile file, void *buf, unsigned len);
int gzclose(gzFile file);
}
#endif
