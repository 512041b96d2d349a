/* Quantized vertex dedup for the marching-cubes mesh: first occurrence wins.
 *
 * Bound with ctypes by gradient_sdf_tpu_torch/ops/marching_cubes.py, whose
 * `dedup_vertices_reference` (a Python loop over a dict) is the plain
 * version the tests hold this code to. It is the JAX package's native
 * `dedup_vertices` (gradient_sdf_tpu/native/gradsdf_native.cpp):
 *   - the key of a vertex is, per coordinate, (double)v * (1.0 / quantum)
 *     rounded half away from zero (C's llround), in double precision;
 *   - ids are handed out in order of first occurrence;
 *   - the unique vertex of an id is the first vertex with that key.
 * C99 has no hash map: keys live in an open-addressing table of 2^k >= 2n
 * slots with linear probing, hashed by the JAX file's function (the same
 * three constants).
 */
#include <stdint.h>
#include <stdlib.h>

/* llround without libm: x - trunc(x) is exact in double, so the tie test
 * is exact too (|x| < 2^63 assumed; vertices are metres over a quantum). */
static int64_t round_half_away(double x)
{
    int64_t t = (int64_t)x;
    double frac = x - (double)t;
    if (frac >= 0.5)
        t += 1;
    else if (frac <= -0.5)
        t -= 1;
    return t;
}

static uint64_t hash_key(const int64_t *k)
{
    uint64_t h = (uint64_t)k[0] * 0x9E3779B185EBCA87ull;
    h ^= (uint64_t)k[1] * 0xC2B2AE3D27D4EB4Full + (h << 6);
    h ^= (uint64_t)k[2] * 0x165667B19E3779F9ull + (h >> 3);
    return h ^ (h >> 32);   /* the table indexes by the low bits */
}

/* verts: f32 [n, 3]; quantum: snap size. Fills index_map [n] with each
 * vertex's id and first [m] with the row of each id's first vertex; returns
 * the number m of unique vertices, or -1 if memory ran out. */
int64_t gsdf_dedup_vertices(const float *verts, int64_t n, double quantum,
                            int32_t *index_map, int64_t *first)
{
    if (n <= 0)
        return 0;
    uint64_t cap = 1;
    while (cap < 2 * (uint64_t)n)
        cap <<= 1;
    const uint64_t mask = cap - 1;
    int32_t *table = malloc(cap * sizeof(int32_t));   /* id, or -1 */
    int64_t *keys = malloc((size_t)n * 3 * sizeof(int64_t));   /* per id */
    if (!table || !keys) {
        free(table);
        free(keys);
        return -1;
    }
    for (uint64_t s = 0; s < cap; s++)
        table[s] = -1;
    const double inv_q = 1.0 / quantum;
    int32_t next_id = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t k[3];
        for (int a = 0; a < 3; a++)
            k[a] = round_half_away((double)verts[3 * i + a] * inv_q);
        uint64_t s = hash_key(k) & mask;
        for (;;) {
            int32_t id = table[s];
            if (id < 0) {
                table[s] = next_id;
                keys[3 * (int64_t)next_id] = k[0];
                keys[3 * (int64_t)next_id + 1] = k[1];
                keys[3 * (int64_t)next_id + 2] = k[2];
                first[next_id] = i;
                index_map[i] = next_id++;
                break;
            }
            const int64_t *q = keys + 3 * (int64_t)id;
            if (q[0] == k[0] && q[1] == k[1] && q[2] == k[2]) {
                index_map[i] = id;
                break;
            }
            s = (s + 1) & mask;
        }
    }
    free(table);
    free(keys);
    return next_id;
}
